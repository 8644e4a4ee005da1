"""DAIS program executor on torch tensors.

``DaisExecutor`` turns a decoded DAIS program into a batched integer kernel
and wraps it with the float boundary (input scaling/floor, output rescale),
so the kernel only ever sees fixed-point integer arithmetic: int32, or int64
when the program's widths demand it (the rule of
``da4ml_tpu/runtime/jax_backend.py:493``, copied exactly).

The executor runs one of four modes, the reference's ``MODES``:

- ``'pallas'``: the hand-written CUDA kernel (``cuda_backend``), which plays
  the reference's Pallas kernel. Its plain version is :class:`LevelPlan`;
  the wrapper runs that plain version when, and only when, it is handed a
  CPU tensor, and on a CUDA tensor it launches the kernel or raises;
- ``'level'``: :class:`LevelPlan`, the lowering of
  ``DaisExecutor._build_level`` in ``jax_backend.py`` as torch ops: ops are
  packed into dependency levels (``ir.schedule``), each (level, family)
  group executes as a few vectorized torch ops — operand gathers,
  shift-by-multiply against precomputed pow2 vectors, fused add/sub via a
  sign vector, two's-complement wrap from per-op (width, signed) tables —
  and writes its contiguous rows of the execution buffer in place;
- ``'unroll'``: :class:`UnrollPlan`, ``_build`` as torch ops, one step per
  op with its constants folded to Python ints;
- ``'scan'``: :class:`ScanPlan`, ``_build_scan`` as torch ops, one
  table-driven step per op over device-resident metadata.

``mode='auto'`` (the default) is the reference's: a static answer for a
small program, else a measured race among the modes whose winner is cached
per (program digest, platform) in memory and in ``run-modes`` under
``DA4ML_TORCH_CACHE`` (``~/.cache/da4ml_tpu_torch``; ``0`` keeps it in
memory). One difference is deliberate: where the reference's static answer
is ``'unroll'`` (one compiled program, nothing to measure), the port's is
``'unroll'`` on the CPU and ``'pallas'`` on a CUDA device, where K1 is the
one-launch mode and unroll issues a launch per step. K1 is one of the race's
candidates on the card, and a K1 that fails raises instead of losing.
``DA4ML_RUN_MODE`` replaces ``'auto'`` only. Force a
mode with ``DaisExecutor(prog, mode='scan', device='cpu')`` (or on the card
with ``device='cuda'``), ``run_comb(comb, data, mode=...)`` or
``run_binary(binary, data, mode=...)``; ``force_i64=True`` runs a narrow
program on the int64 path.

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
``da4ml_tpu/runtime/jax_backend.py``, without the packed transfers
(``_pack_plan``, ``_wrap_packed``), sharding and model-shard paths.

Telemetry, as the reference records it: each call is one ``run.call`` span
(``mode`` the executor's resolved mode, and the pipelines'
``'pipeline-fused'`` / ``'pipeline-chained'``) whose device work runs inside
``telemetry.obs.profile.annotate('run.call')``, and one sample of the
``run.*`` metrics; ``run.device_s`` is the boundary's upload, kernel and
download, timed where the call already waits for its output.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from collections import OrderedDict
from functools import cached_property, lru_cache

import numpy as np
import torch
from numpy.typing import NDArray

from .. import telemetry
from ..ir.dais_binary import DaisProgram, decode
from ..ir.optable import OP_TABLE, VECTOR_CLASS
from ..ir.schedule import LevelSchedule, levelize_program, operand_edges
from ..telemetry.obs import profile as _prof
from . import MODES, UNROLL_LIMIT


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
    """Gathered per-op operand metadata shared by the scan and level
    lowerings and the CUDA kernel's op records (numpy, original op order;
    garbage where a family ignores a field). The reference's ``_op_meta``,
    field for field."""
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
# unroll lowering: ``_build`` of jax_backend.py as torch ops, one step per op
# with every constant folded to a Python int
# ---------------------------------------------------------------------------


def _shl(v, s: int):
    return v << s if s >= 0 else v >> (-s)


def _wrap_int(v, signed: int, w: int):
    mod = 1 << w
    int_min = -(1 << (w - 1)) if signed else 0
    return ((v - int_min) % mod) + int_min


def _quantize_int(v, f_from: int, sg: int, w: int, f_to: int):
    return _wrap_int(_shl(v, f_to - f_from), sg, w)


def _unroll_step(prog: DaisProgram, i: int, np_dt):
    """Op ``i`` of ``prog`` as ``step(buf, xT, tabs)`` -> its (batch,) row:
    ``buf`` the rows of the ops before it, ``xT`` the (n_in, batch) inputs,
    ``tabs`` the lookup tables on the device. The reference's op-by-op chain
    (``jax_backend.DaisExecutor._build``), branch for branch."""
    width = prog.width
    oc = int(prog.opcode[i])
    i0, i1 = int(prog.id0[i]), int(prog.id1[i])
    dlo, dhi = int(prog.data_lo[i]), int(prog.data_hi[i])
    sg, f = int(prog.signed[i]), int(prog.fractionals[i])
    w = int(width[i])
    # the 64-bit payload in the executor's dtype, as jnp.asarray gives it
    const = int(np.array((dhi << 32) | (dlo & 0xFFFFFFFF), np.int64).astype(np_dt))

    if oc == -1:
        return lambda buf, xT, tabs: _wrap_int(xT[i0], sg, w)
    if oc in (0, 1):
        f0, f1 = int(prog.fractionals[i0]), int(prog.fractionals[i1])
        a_shift = dlo + f0 - f1
        g_shift = max(f0, f1 - dlo) - f
        sub = oc == 1

        def addsub(buf, xT, tabs):
            v1 = buf[i0]
            v2 = -buf[i1] if sub else buf[i1]
            r = v1 + (v2 << a_shift) if a_shift > 0 else (v1 << -a_shift) + v2
            return r >> g_shift if g_shift > 0 else r

        return addsub
    if oc in (2, -2, 3, -3):
        f_from, neg, relu = int(prog.fractionals[i0]), oc < 0, abs(oc) == 2

        def shift_wrap(buf, xT, tabs):
            v = -buf[i0] if neg else buf[i0]
            q = _quantize_int(v, f_from, sg, w, f)
            return q.masked_fill(v < 0, 0) if relu else q

        return shift_wrap
    if oc == 4:
        shift = f - int(prog.fractionals[i0])
        return lambda buf, xT, tabs: _shl(buf[i0], shift) + const
    if oc == 5:
        return lambda buf, xT, tabs: xT.new_full((xT.shape[1],), const)
    if oc in (6, -6):
        ic, neg = dlo, oc < 0
        f0, f1 = int(prog.fractionals[i0]), int(prog.fractionals[i1])
        shift1 = f - f1 + dhi
        shift0 = f - f0
        sgc, wc = int(prog.signed[ic]), int(width[ic])
        thr = 0 if sgc else 1 << (wc - 1)

        def mux(buf, xT, tabs):
            cond = buf[ic] < 0 if sgc else buf[ic] >= thr
            v1 = -buf[i1] if neg else buf[i1]
            r0 = _wrap_int(_shl(buf[i0], shift0), sg, w)
            r1 = _wrap_int(_shl(v1, shift1), sg, w)
            return torch.where(cond, r0, r1)

        return mux
    if oc == 7:
        return lambda buf, xT, tabs: buf[i0] * buf[i1]
    if oc == 8:
        sg0, w0 = int(prog.signed[i0]), int(width[i0])
        zero = -sg0 * (1 << (w0 - 1))
        last = len(prog.tables[dlo]) - 1

        def lookup(buf, xT, tabs):
            index = buf[i0] - zero - dhi
            return tabs[dlo].take(index.clamp(0, last).long())

        return lookup
    if oc in (9, -9):
        neg = oc < 0
        mask = (1 << int(width[i0])) - 1
        if dlo not in (0, 1, 2):
            raise ValueError(f'Unknown bit unary op data={dlo}')

        def bit_unary(buf, xT, tabs):
            v = -buf[i0] if neg else buf[i0]
            if dlo == 0:
                return ~v if sg else (~v) & mask
            if dlo == 1:
                return (v != 0).to(v.dtype)
            return ((v & mask) == mask).to(v.dtype)

        return bit_unary
    if oc == 10:
        f0, f1 = int(prog.fractionals[i0]), int(prog.fractionals[i1])
        a_shift = dlo + f0 - f1
        subop = dhi >> 24

        def bit_binary(buf, xT, tabs):
            v1, v2 = buf[i0], buf[i1]
            if dhi & 1:
                v1 = -v1
            if dhi & 2:
                v2 = -v2
            if a_shift > 0:
                v2 = v2 << a_shift
            else:
                v1 = v1 << -a_shift
            return (v1 & v2) if subop == 0 else (v1 | v2) if subop == 1 else (v1 ^ v2)

        return bit_binary
    raise ValueError(f'Unknown opcode {oc} at index {i}')


class UnrollPlan:
    """The ``unroll`` lowering (``mode='unroll'``): ``_build`` of the JAX
    package's executor as torch ops. Each op is one step whose operand ids,
    shifts, widths and constants are Python ints folded in at build time
    (``_unroll_step``); the steps run in program order over a list of
    (batch,) rows, and a row is dropped after its last reader so the working
    set stays the live values. ``plan(x)`` maps a (batch, n_in) integer
    tensor on any device to (batch, n_out), in the executor's dtype."""

    def __init__(self, ex: 'DaisExecutor'):
        prog = ex.prog
        self.dtype = ex.dtype
        self.prog = prog
        self.steps = [_unroll_step(prog, i, ex.np_dtype) for i in range(prog.n_ops)]
        # each op's last reader (itself when none reads it); outputs live to the end
        n = prog.n_ops
        last = np.arange(n, dtype=np.int64)
        readers, operands = operand_edges(prog.opcode, prog.id0, prog.id1, prog.data_lo)
        np.maximum.at(last, operands, readers)
        last[prog.out_idxs[prog.out_idxs >= 0].astype(np.int64)] = n
        self.dead: list[list[int]] = [[] for _ in range(n)]
        for j, at in enumerate(last.tolist()):
            if at < n:
                self.dead[at].append(j)
        self._tabs: dict[torch.device, list[torch.Tensor]] = {}
        self._np_tables = [np.asarray(t, ex.np_dtype) for t in prog.tables]

    def _tables(self, device: torch.device) -> list[torch.Tensor]:
        hit = self._tabs.get(device)
        if hit is None:
            hit = self._tabs[device] = [torch.from_numpy(t).to(device) for t in self._np_tables]
        return hit

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != self.dtype or x.dim() != 2:
            raise ValueError(f'unroll plan takes a 2-D {self.dtype} tensor, got {x.dtype} of shape {tuple(x.shape)}')
        prog, tabs = self.prog, self._tables(x.device)
        xT = x.t().contiguous()
        buf: list = [None] * prog.n_ops
        for i, (step, dead) in enumerate(zip(self.steps, self.dead)):
            buf[i] = step(buf, xT, tabs)
            for j in dead:
                buf[j] = None
        outs = []
        for j in range(prog.n_out):
            idx = int(prog.out_idxs[j])
            if idx < 0:
                outs.append(x.new_zeros((x.shape[0],)))
                continue
            v = buf[idx]
            outs.append(-v if prog.out_negs[j] else v)
        if not outs:
            return x.new_zeros((x.shape[0], 0))
        return torch.stack(outs, dim=1)


# ---------------------------------------------------------------------------
# scan lowering: ``_build_scan`` of jax_backend.py as torch ops, one
# table-driven step per op over a dense buffer
# ---------------------------------------------------------------------------


def _shl_t(v, s):
    """Shift by a traced amount: left by max(s, 0), then right by max(-s, 0)."""
    return torch.bitwise_left_shift(v, torch.clamp_min(s, 0)) >> torch.clamp_min(-s, 0)


def _wrap_t(v, sg, w):
    mod = 1 << w
    int_min = torch.where(sg != 0, -(1 << (w - 1)), 0)
    return ((v - int_min) % mod) + int_min


class _ScanRow:
    """Op ``t``'s row of the scan table ``P``: ``p[k]`` is field ``k`` as a
    one-element view of its device column (no copy, no launch)."""

    __slots__ = ('P', 't')

    def __init__(self, P: dict, t: int):
        self.P, self.t = P, t

    def __getitem__(self, k: str) -> torch.Tensor:
        return self.P[k][self.t : self.t + 1]


def _scan_copy(buf, xT, p):
    return _wrap_t(xT.index_select(0, p['id0']), p['sg'], p['w'])


def _scan_addsub(buf, xT, p):
    x0, x1 = buf.index_select(0, p['id0']), buf.index_select(0, p['id1'])
    v2 = torch.where(p['issub'] != 0, -x1, x1)
    a = p['a_shift']
    r = torch.where(a > 0, x0 + _shl_t(v2, torch.clamp_min(a, 0)), _shl_t(x0, torch.clamp_min(-a, 0)) + v2)
    g = p['g_shift']
    return torch.where(g > 0, r >> torch.clamp_min(g, 0), r)


def _scan_shift_wrap(relu: bool):
    def branch(buf, xT, p):
        x0 = buf.index_select(0, p['id0'])
        v = torch.where(p['neg'] != 0, -x0, x0)
        q = _wrap_t(_shl_t(v, p['f'] - p['f0']), p['sg'], p['w'])
        return torch.where(v < 0, 0, q) if relu else q

    return branch


def _scan_const_add(buf, xT, p):
    return _shl_t(buf.index_select(0, p['id0']), p['f'] - p['f0']) + p['const']


def _scan_const(buf, xT, p):
    return p['const']  # broadcast over the row when it is written


def _scan_msb_mux(buf, xT, p):
    vc = buf.index_select(0, p['dlo'])
    cond = torch.where(p['sgc'] != 0, vc < 0, vc >= (1 << (p['wc'] - 1)))
    x0, x1 = buf.index_select(0, p['id0']), buf.index_select(0, p['id1'])
    v1 = torch.where(p['neg'] != 0, -x1, x1)
    r0 = _wrap_t(_shl_t(x0, p['mux_s0']), p['sg'], p['w'])
    r1 = _wrap_t(_shl_t(v1, p['mux_s1']), p['sg'], p['w'])
    return torch.where(cond, r0, r1)


def _scan_mul(buf, xT, p):
    return buf.index_select(0, p['id0']) * buf.index_select(0, p['id1'])


def _scan_lookup(buf, xT, p):
    index = buf.index_select(0, p['id0']) - p['lut_zero'] - p['dhi'] + p['tab_off']
    index = torch.clamp(index, p['tab_off'], p['tab_end'])
    return p.P['flat_tab'].take(index.long())


def _scan_bit_unary(buf, xT, p):
    x0 = buf.index_select(0, p['id0'])
    v = torch.where(p['neg'] != 0, -x0, x0)
    mask = p['mask0']
    r_not = torch.where(p['sg'] != 0, ~v, (~v) & mask)
    r_any = (v != 0).to(v.dtype)
    r_all = ((v & mask) == mask).to(v.dtype)
    d = p['dlo']
    return torch.where(d == 0, r_not, torch.where(d == 1, r_any, r_all))


def _scan_bit_binary(buf, xT, p):
    x0, x1 = buf.index_select(0, p['id0']), buf.index_select(0, p['id1'])
    v1 = torch.where(p['bb_neg0'] != 0, -x0, x0)
    v2 = torch.where(p['bb_neg1'] != 0, -x1, x1)
    a = p['a_shift']
    v2 = torch.where(a > 0, _shl_t(v2, torch.clamp_min(a, 0)), v2)
    v1 = torch.where(a > 0, v1, _shl_t(v1, torch.clamp_min(-a, 0)))
    so = p['bb_subop']
    return torch.where(so == 0, v1 & v2, torch.where(so == 1, v1 | v2, v1 ^ v2))


#: the scan step's branches, keyed by ``OpSpec.lower`` like ``LEVEL_EMITTERS``
SCAN_BRANCHES: dict[str, object] = {
    'copy': _scan_copy,
    'addsub': _scan_addsub,
    'relu': _scan_shift_wrap(relu=True),
    'quantize': _scan_shift_wrap(relu=False),
    'const_add': _scan_const_add,
    'const': _scan_const,
    'msb_mux': _scan_msb_mux,
    'mul': _scan_mul,
    'lookup': _scan_lookup,
    'bit_unary': _scan_bit_unary,
    'bit_binary': _scan_bit_binary,
}

if set(SCAN_BRANCHES) != set(LEVEL_EMITTERS):
    raise RuntimeError('scan branches out of step with the opcode table lower column')


class ScanPlan:
    """The ``scan`` lowering (``mode='scan'``): ``_build_scan`` of the JAX
    package's executor as torch ops.

    The per-op metadata of ``op_meta`` is a table of device columns (the
    reference's scan table ``P``: gather ids as int64, the rest in the
    executor's dtype), moved to a device on its first use there. One step
    per op runs in program order against a dense ``[n_ops, batch]`` buffer:
    its operands are gathered from the buffer by the ``id0``/``id1`` (and
    mux ``dlo``) columns, its shifts are traced from the table (``_shl_t``:
    left by max(s, 0), right by max(-s, 0)), ``wrap`` reads the per-op
    ``sg``/``w``, and the result is written to row ``t``. ``lax.switch`` on
    the op's ``branch`` becomes a host-side switch over the branch column,
    one of ``SCAN_BRANCHES`` a step, so each step launches only its own
    family's ops. ``plan(x)`` maps a (batch, n_in) integer tensor on any
    device to (batch, n_out), in the executor's dtype."""

    #: table columns used as gather indices (int64 on the device)
    INDEX_FIELDS = ('id0', 'id1', 'dlo')
    #: table columns in the executor's dtype
    VALUE_FIELDS = ('neg', 'issub', 'f', 'sg', 'w', 'f0', 'a_shift', 'g_shift', 'const', 'sgc', 'wc', 'mux_s0',
                    'mux_s1', 'tab_off', 'tab_end', 'lut_zero', 'mask0', 'bb_neg0', 'bb_neg1', 'bb_subop',
                    'dhi')  # fmt: skip

    def __init__(self, ex: 'DaisExecutor'):
        prog, m = ex.prog, ex.meta
        self.dtype = ex.dtype
        self.n_ops, self.n_in = prog.n_ops, prog.n_in
        self.branches = [SCAN_BRANCHES[OP_TABLE[int(b)].lower] for b in m['branch']]
        self.table = {k: np.ascontiguousarray(m[k], np.int64) for k in self.INDEX_FIELDS}
        self.table.update({k: np.ascontiguousarray(m[k].astype(ex.np_dtype)) for k in self.VALUE_FIELDS})
        self.table['flat_tab'] = np.ascontiguousarray(m['flat_tab'])
        out_idx = prog.out_idxs.astype(np.int64)
        self.table['out_rows'] = np.maximum(out_idx, 0)
        self.table['out_sign'] = np.where(out_idx < 0, 0, np.where(prog.out_negs != 0, -1, 1)).astype(ex.np_dtype)[:, None]
        self._on: dict[torch.device, dict[str, torch.Tensor]] = {}

    def _table(self, device: torch.device) -> dict[str, torch.Tensor]:
        hit = self._on.get(device)
        if hit is None:
            hit = self._on[device] = {k: torch.from_numpy(v).to(device) for k, v in self.table.items()}
        return hit

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != self.dtype or x.dim() != 2:
            raise ValueError(f'scan plan takes a 2-D {self.dtype} tensor, got {x.dtype} of shape {tuple(x.shape)}')
        P = self._table(x.device)
        batch = x.shape[0]
        # an all-const program keeps one dummy lane, as the reference does
        xT = x.t().contiguous() if self.n_in else x.new_zeros((1, batch))
        buf = torch.empty((max(self.n_ops, 1), batch), dtype=self.dtype, device=x.device)
        for t, branch in enumerate(self.branches):
            buf[t : t + 1] = branch(buf, xT, _ScanRow(P, t))
        return (buf.index_select(0, P['out_rows']) * P['out_sign']).t().contiguous()


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


# ---------------------------------------------------------------------------
# mode='auto': the decision cache, in memory per process and persisted per
# (program digest, platform) in the port's own cache directory
# ---------------------------------------------------------------------------

_MODE_DECISIONS: dict[tuple[str, str], str] = {}


def mode_decisions() -> dict[str, str]:
    """In-process ``mode='auto'`` decisions (``digest@platform`` -> mode), as
    ``/statusz`` shows them. A decision is keyed by (program digest,
    platform): one measured on the CPU never answers for the card."""
    return {f'{d}@{p}': mode for (d, p), mode in _MODE_DECISIONS.items()}


def _mode_cache_dir() -> str | None:
    """The directory of persisted decisions: ``run-modes`` under
    ``DA4ML_TORCH_CACHE``, else under ``~/.cache/da4ml_tpu_torch``;
    ``DA4ML_TORCH_CACHE=0`` (``none``, ``off``) keeps them in memory only."""
    base = os.environ.get('DA4ML_TORCH_CACHE', '').strip()
    if base.lower() in ('0', 'none', 'off'):
        return None
    path = os.path.join(base or os.path.expanduser('~/.cache/da4ml_tpu_torch'), 'run-modes')
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    return path


def _platform(device: torch.device) -> str:
    """The platform half of the decision key: ``'cuda'`` or ``'cpu'``."""
    return device.type


def _decision_path(d: str, digest: str, platform: str) -> str:
    # the platform is a key of its own, not folded into the digest: a decision
    # measured on the CPU must never answer for the same program on the card
    return os.path.join(d, f'{digest}.{platform}.json')


def _load_mode_decision(digest: str, platform: str) -> str | None:
    """The decision for (digest, platform), from memory or its file; a file
    that is unreadable, corrupt or of another platform is ignored."""
    mode = _MODE_DECISIONS.get((digest, platform))
    if mode:
        return mode
    d = _mode_cache_dir()
    if not d:
        return None
    try:
        with open(_decision_path(d, digest, platform)) as fh:
            blob = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(blob, dict):
        return None
    mode = blob.get('mode')
    if mode in MODES and blob.get('platform', platform) == platform:
        _MODE_DECISIONS[(digest, platform)] = mode
        return mode
    return None


def _store_mode_decision(digest: str, platform: str, mode: str, info: dict) -> None:
    """Keep a decision in memory and write it to its file atomically (a
    temporary file named with the pid, then ``os.replace``)."""
    _MODE_DECISIONS[(digest, platform)] = mode
    d = _mode_cache_dir()
    if not d:
        return
    path = _decision_path(d, digest, platform)
    tmp = f'{path}.tmp{os.getpid()}'
    try:
        with open(tmp, 'w') as fh:
            json.dump({'mode': mode, 'platform': platform, **info}, fh)
        os.replace(tmp, path)
    except OSError:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _launch_floor_s(device: torch.device, reps: int = 256) -> float:
    """The smallest host time of one launch on ``device``: the best of five
    runs of ``reps`` in-place adds to a one-element tensor, each run ended by
    a synchronize. No plan's op issues faster, so ``launches * floor`` is a
    lower bound on a plan's call."""
    t = torch.zeros(1, dtype=torch.int32, device=device)
    sync = _synchronizer(device)
    best = float('inf')
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            t.add_(1)
        sync()
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def _synchronizer(device: torch.device):
    if device.type == 'cuda':
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


class DaisExecutor:
    """A DAIS program as a batched integer kernel on one device.

    ``fn_int`` maps a (batch, n_in) integer tensor to (batch, n_out) through
    the plan of the executor's ``mode``; ``__call__`` wraps it with the call
    boundary (``boundary_call``).

    ``force_i64`` forces (True) or forbids (False) the int64 path; None
    takes it when the program's widths demand it. ``mode`` is one of
    ``MODES`` or ``'auto'``:

    - ``'pallas'``: the CUDA kernel K1 (``cuda_backend.DaisKernel``), the
      counterpart of the reference's Pallas kernel. On a CUDA tensor it
      launches K1 or raises; nothing falls back. On a CPU tensor the wrapper
      runs its plain version, as the reference runs Pallas in interpret mode;
    - ``'level'``: :class:`LevelPlan`, K1's plain version, as torch ops;
    - ``'unroll'``: :class:`UnrollPlan`, one step per op with its constants
      folded; refuses programs over ``UNROLL_LIMIT`` ops;
    - ``'scan'``: :class:`ScanPlan`, one table-driven step per op;
    - ``'auto'``: the reference's rule, measured (``_select_mode``). A
      program of at most ``autotune_min_ops`` ops (``AUTOTUNE_MIN_OPS``,
      ``DA4ML_RUN_AUTOTUNE_MIN_OPS``) takes the static answer, as does any
      program under ``DA4ML_RUN_AUTOTUNE=0``; a larger one is raced among
      the modes (``_autotune``) and the winner kept per (program digest,
      platform). The static answer differs by device, on purpose: on the
      CPU it is the reference's own (``'unroll'`` up to the limits, and
      ``'level'`` above ``UNROLL_LIMIT`` with the race off); on a CUDA
      device it is ``'pallas'``, at every size. The reference's unroll
      stands for one compiled program that needs no measurement; on the
      card the port's one-launch mode is K1, and its unroll is a launch per
      step (33.9–56.7 ms against K1's 1.6 ms on the flagship at 2^20
      samples, NVIDIA H100 80GB HBM3). ``DA4ML_RUN_MODE`` (one of
      ``MODES``) replaces ``'auto'`` first, never an explicit mode.

    ``self.mode`` is the resolved mode. The call boundary, the chunking and
    the telemetry are the same in every mode.
    """

    #: ``runtime.UNROLL_LIMIT``, on the class as on the reference's executor
    UNROLL_LIMIT = UNROLL_LIMIT

    #: at or below this op count ``mode='auto'`` takes the static answer
    #: without a race (the reference's value)
    AUTOTUNE_MIN_OPS = 1024

    #: rows of the race's synthetic batch, at most (``DA4ML_RUN_AUTOTUNE_BATCH``)
    AUTOTUNE_BATCH = 4096

    def __init__(self, prog: DaisProgram, force_i64: bool | None = None, mode: str = 'auto', device=None,
                 autotune_min_ops: int | None = None):  # fmt: skip
        """``autotune_min_ops`` replaces ``AUTOTUNE_MIN_OPS`` for this
        executor: 0 races every program, as ``fused_executor_for_binaries``
        does (a fused program is deep even when it is small)."""
        prog.validate()
        self.prog = prog
        if mode not in ('auto', *MODES):
            raise ValueError(f"mode must be 'auto', 'unroll', 'scan', 'level' or 'pallas', got {mode!r}")
        if force_i64 is not None and not isinstance(force_i64, (bool, np.bool_)):
            raise TypeError(f'force_i64 must be None, True or False, got {force_i64!r} (pass the device as device=)')
        self.device = resolve_device(device)
        self._autotune_min_ops = autotune_min_ops
        # +2 headroom: shift_add aligns operands before the narrowing shift
        wide = prog.max_width + 2 > 31
        self.use_i64 = wide if force_i64 is None else bool(force_i64)
        self.dtype = torch.int64 if self.use_i64 else torch.int32
        self.np_dtype = np.int64 if self.use_i64 else np.int32
        self.meta = op_meta(prog, self.use_i64)
        env_mode = _env_mode().strip().lower()
        if mode == 'auto' and env_mode in MODES:
            mode = env_mode
        plan = None
        if mode == 'auto':
            mode, plan = self._select_mode()
        if mode == 'unroll' and prog.n_ops > self.UNROLL_LIMIT:
            raise ValueError(
                f"mode='unroll' refuses a {prog.n_ops}-op program (compile time grows with program "
                f"size; UNROLL_LIMIT={self.UNROLL_LIMIT}). Use mode='level'."
            )
        self.mode = mode
        self._in_scale = self._inp_scale()
        self._out_sf = self._out_scale()
        self._scales: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
        #: the mode's integer function, the race's winner as it was built (K1's
        #: wrapper packs its records at its first launch, so a CPU executor
        #: never builds them)
        self.plan = plan if plan is not None else self._build_plan(mode)
        self._compile_recorded = False
        telemetry.counter(f'run.mode.{self.mode}').inc()

    def _build_plan(self, mode: str):
        return {'unroll': UnrollPlan, 'scan': ScanPlan, 'level': lambda ex: ex.plain,
                'pallas': lambda ex: ex.kernel}[mode](self)  # fmt: skip

    @cached_property
    def schedule(self) -> LevelSchedule:
        """The level schedule of ``LevelPlan`` and K1 (built on first use)."""
        return levelize_program(self.prog, sort_key=self.meta['branch'].astype(np.int64))

    @cached_property
    def plain(self) -> LevelPlan:
        """K1's plain version (``mode='level'``), built on first use."""
        return LevelPlan(self)

    @cached_property
    def kernel(self):
        """K1's wrapper (built on first use)."""
        from .cuda_backend import DaisKernel

        return DaisKernel(self)

    # -- mode='auto' ---------------------------------------------------------

    def _digest(self) -> str:
        """The program and environment digest keying the decision cache: the
        reference's twelve program arrays and its tables, hashed as it hashes
        them, then ``n_in``, ``n_out``, ``use_i64``, torch's version, the
        card's name on a CUDA device and K1's build digest (a changed K1 is
        raced again). The platform is the key's other half, not hashed."""
        from .cuda_backend import build_digest

        prog = self.prog
        h = hashlib.sha1()
        for a in (
            prog.inp_shifts, prog.out_idxs, prog.out_shifts, prog.out_negs, prog.opcode, prog.id0,
            prog.id1, prog.data_lo, prog.data_hi, prog.signed, prog.integers, prog.fractionals,
        ):  # fmt: skip
            h.update(np.ascontiguousarray(a, dtype=np.int64).tobytes())
        for t in prog.tables:
            h.update(np.ascontiguousarray(t, dtype=np.int64).tobytes())
        card = torch.cuda.get_device_name(self.device) if self.device.type == 'cuda' else ''
        h.update(f'|{prog.n_in}|{prog.n_out}|{self.use_i64}|{torch.__version__}|{card}|{build_digest()}'.encode())
        return h.hexdigest()

    def _select_mode(self) -> tuple[str, object]:
        """Resolve ``mode='auto'``: the static answer for a program of at
        most ``autotune_min_ops`` ops or with ``DA4ML_RUN_AUTOTUNE=0``, else
        the cached decision for (digest, platform), else the race. Returns
        ``(mode, plan)``: the race hands back its winner's built plan, the
        other answers None."""
        n_ops = self.prog.n_ops
        min_ops = self._autotune_min_ops
        if min_ops is None:
            try:
                min_ops = int(os.environ.get('DA4ML_RUN_AUTOTUNE_MIN_OPS', '') or self.AUTOTUNE_MIN_OPS)
            except ValueError:
                min_ops = self.AUTOTUNE_MIN_OPS
        # the reference's one compiled program: its unroll; the card's is K1
        static = 'pallas' if self.device.type == 'cuda' else 'unroll'
        if n_ops <= min(min_ops, self.UNROLL_LIMIT):
            return static, None
        if os.environ.get('DA4ML_RUN_AUTOTUNE', '1').strip().lower() in ('0', 'off', 'false'):
            if static == 'unroll' and n_ops > self.UNROLL_LIMIT:
                return 'level', None
            return static, None
        digest, platform = self._digest(), _platform(self.device)
        cached = _load_mode_decision(digest, platform)
        if cached is not None:
            telemetry.counter('run.mode_cache_hit').inc()
            return cached, None
        return self._autotune(digest, platform)

    def _candidates(self) -> list[str]:
        """The race's modes in the order they run, cheapest first: K1 where
        ``cuda_backend.autotune_candidate`` says so, then the reference's
        rule (``level``, ``unroll``, ``scan`` up to ``UNROLL_LIMIT``; above
        it ``level`` and ``scan``, or ``scan`` alone on a chain-shaped
        program of fewer than 4 ops a level)."""
        from .cuda_backend import autotune_candidate

        prog = self.prog
        if prog.n_ops <= self.UNROLL_LIMIT:
            modes = ['level', 'unroll', 'scan']
        else:
            depth = self.schedule.depth
            modes = ['scan'] if depth and prog.n_ops / depth < 4 else ['level', 'scan']
        return (['pallas'] if autotune_candidate(self.device) else []) + modes

    def _min_launches(self, mode: str) -> int:
        """A lower bound on the launches one call of ``mode``'s plan issues:
        K1 one; ``level`` one a (level, family) group; ``unroll`` one an op;
        ``scan`` its row write an op and, but for a constant, one more."""
        n_ops = self.prog.n_ops
        if mode == 'pallas':
            return 1
        if mode == 'level':
            return max(len(level_groups(self.schedule, self.meta['branch'].astype(np.int64))), 1)
        if mode == 'unroll':
            return n_ops
        return 2 * n_ops - int(np.count_nonzero(self.prog.opcode == 5))

    def _race_batch(self) -> torch.Tensor:
        """The reference's synthetic race batch as a tensor on the device: at
        most ``DA4ML_RUN_AUTOTUNE_BATCH`` (``AUTOTUNE_BATCH``) rows, and no
        more than one ``CHUNK_BYTES`` chunk of the call boundary's float64
        rows holds, so the race allocates no more than a call would."""
        prog = self.prog
        try:
            rows = int(os.environ.get('DA4ML_RUN_AUTOTUNE_BATCH', '') or self.AUTOTUNE_BATCH)
        except ValueError:
            rows = self.AUTOTUNE_BATCH
        rows = max(1, min(rows, CHUNK_BYTES // (8 * max(prog.n_in, 1))))
        x = torch.arange(rows * prog.n_in, dtype=torch.int64, device=self.device).reshape(rows, prog.n_in)
        return ((x * 2654435761) % 255 - 127).to(self.dtype)

    def _autotune(self, digest: str, platform: str) -> tuple[str, object]:
        """Race the candidate modes on the synthetic batch: each is built,
        run once warm, then timed best of two (synchronized on the card);
        ``compile_s`` is the build and the first call. A candidate whose
        lower bound (``_min_launches`` times ``_launch_floor_s``) already
        exceeds the best time is skipped, recorded as
        ``<mode>_skipped_bound_s``: the bound is a lower bound, so a skip
        never changes the winner. A candidate that fails raises: K1 never
        loses a race by failing. The decision persists under (digest,
        platform); returns ``(winner, its plan)``."""
        candidates = self._candidates()
        x = self._race_batch()
        sync = _synchronizer(self.device)
        floor_s = _launch_floor_s(self.device)
        info: dict[str, float] = {'batch': x.shape[0], 'launch_floor_s': floor_s}
        best = None
        with telemetry.span('run.autotune', n_ops=self.prog.n_ops, candidates=','.join(candidates)):
            for m in candidates:
                bound_s = self._min_launches(m) * floor_s
                if best is not None and bound_s > best[0]:
                    info[f'{m}_skipped_bound_s'] = bound_s
                    continue
                t0 = time.perf_counter()
                plan = self._build_plan(m)
                plan(x)
                sync()
                compile_s = time.perf_counter() - t0
                run_s = float('inf')  # best of two: one noisy sample can invert the ranking
                for _ in range(2):
                    t0 = time.perf_counter()
                    plan(x)
                    sync()
                    run_s = max(min(run_s, time.perf_counter() - t0), 1e-9)
                telemetry.histogram('run.compile_s').observe(compile_s)
                info[f'{m}_compile_s'] = round(compile_s, 6)
                info[f'{m}_samples_per_s'] = round(x.shape[0] / run_s, 1)
                if best is None or run_s < best[0]:
                    best = (run_s, m, plan)
        _, mode, plan = best
        if mode != 'pallas':
            # a losing K1 leaves with its packed records and launch tensors
            self.__dict__.pop('kernel', None)
        telemetry.counter('run.autotune').inc()
        _store_mode_decision(digest, platform, mode, info)
        return mode, plan

    def fn_int(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, n_in) integer tensor -> (batch, n_out), on x's device,
        through the plan of ``self.mode``."""
        return self.plan(x)

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


def _env_mode() -> str:
    """``DA4ML_RUN_MODE`` as set (a mode replaces ``'auto'``; the executor
    caches key on it)."""
    return os.environ.get('DA4ML_RUN_MODE', '')


def executor_for_binary(binary: NDArray[np.int32], mode: str = 'auto', device=None) -> DaisExecutor:
    """A cached executor for a DAIS binary in ``mode`` on ``device`` (LRU,
    256 entries), keyed by the binary, the mode, ``DA4ML_RUN_MODE`` and the
    device."""
    dev = resolve_device(device)
    key = (np.asarray(binary, dtype=np.int32).tobytes(), mode, _env_mode(), str(dev))
    return _cached(_executor_cache, key, lambda: DaisExecutor(decode(binary), mode=mode, device=dev))


def run_binary(binary: NDArray[np.int32], data: NDArray[np.float64], device=None, mode: str = 'auto') -> NDArray[np.float64]:
    return executor_for_binary(binary, mode=mode, device=device)(data)


def _pipeline_key(binaries: list[NDArray[np.int32]]) -> bytes:
    # length-prefixed segments: plain concatenation would let two different
    # stage lists with identical byte streams collide
    return b''.join(
        len(bs := np.asarray(b, dtype=np.int32).tobytes()).to_bytes(8, 'little') + bs for b in binaries
    )


def fused_executor_for_binaries(binaries: list[NDArray[np.int32]], mode: str = 'auto', device=None) -> DaisExecutor:
    """A cached executor over the IR-fused pipeline in ``mode`` on
    ``device``: the per-stage binaries merged into ONE DAIS program
    (``ir.fuse.fuse_binaries``), so the kernel runs the whole pipeline in one
    launch a chunk. Keyed as ``executor_for_binary``'s cache."""
    dev = resolve_device(device)

    def build():
        from ..ir.fuse import fuse_binaries

        # autotune_min_ops=0: always race, as the reference does; a fused
        # program is deep even when its op count is small
        ex = DaisExecutor(decode(fuse_binaries(binaries)), mode=mode, device=dev, autotune_min_ops=0)
        telemetry.counter('run.mode.fused_ir').inc()
        return ex

    return _cached(_fused_ir_cache, (_pipeline_key(binaries), mode, _env_mode(), str(dev)), build)


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
        return fused_executor_for_binaries(binaries, device=device)(data)
    ex = pipeline_executor_for_binaries(binaries, device)
    return ex(data) if fused else ex.chained(data)
