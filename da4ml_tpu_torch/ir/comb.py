"""CombLogic and Pipeline — the executable DAIS program containers.

``CombLogic`` is one block of fully-combinational SSA ops. ``Pipeline`` chains
CombLogic stages at II=1. Both replay symbolically (over tracer variables) or
numerically (over floats) via ``__call__``; batch bit-exact execution goes
through the port's runtime (the torch executor, or the host interpreters) by
``predict``. ``Pipeline.fuse`` merges the stages into one program
(``ir/fuse.py``).

Counterpart of ``da4ml_tpu/ir/comb.py``.
"""

from __future__ import annotations

import json
from functools import reduce
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
from numpy.typing import NDArray

from ..ops.numeric import apply_quantize
from .lut import LookupTable
from .optable import OP_TABLE
from .types import Op, QInterval, minimal_kif

#: per-opcode replay semantics, generated from the opcode table
_REPLAY: dict[int, object] = {oc: spec.replay for spec in OP_TABLE for oc in spec.opcodes}


class CombLogic(NamedTuple):
    """A combinational SSA program: ops fill a buffer; outputs are scaled reads.

    ``shape`` = (n_in, n_out); ``inp_shifts`` scale inputs on entry;
    outputs are ``buf[out_idxs[i]] * 2**out_shifts[i] * (-1 if out_negs[i])``.
    ``carry_size``/``adder_size`` parameterize the cost/latency model.
    """

    shape: tuple[int, int]
    inp_shifts: list[int]
    out_idxs: list[int]
    out_shifts: list[int]
    out_negs: list[bool]
    ops: list[Op]
    carry_size: int
    adder_size: int
    lookup_tables: tuple[LookupTable, ...] | None = None

    def __call__(self, inp, quantize: bool = False, dump: bool = False):
        """Replay the op list over the input — numeric (floats) or symbolic."""
        values = list(np.asarray(inp))
        if quantize:
            ks, is_, fs = self.inp_kifs
            values = [apply_quantize(x, k, i, f, round_mode='TRN') for x, k, i, f in zip(values, ks, is_, fs)]
        scaled = [v * 2.0**s for v, s in zip(values, self.inp_shifts)]

        buf: list = []
        for op in self.ops:
            handler = _REPLAY.get(op.opcode)
            if handler is None:
                raise ValueError(f'Unknown opcode {op.opcode} in {op}')
            buf.append(handler(self, op, buf, scaled))

        if dump:
            return np.array(buf, dtype=object)
        out = []
        for idx, sh, neg in zip(self.out_idxs, self.out_shifts, self.out_negs):
            v = buf[idx] * 2.0**sh
            if neg:
                v = -v
            # idx < 0 marks a dead output lane; keep a typed zero of the
            # replayed element kind (symbolic zero under symbolic replay)
            out.append(v * 0 if idx < 0 else v)
        return np.array(out, dtype=object)

    # ---------------------------------------------------------------- metrics

    @property
    def kernel(self) -> NDArray[np.float32]:
        """The linear kernel this program implements (one-hot replay)."""
        kernel = np.empty(self.shape, dtype=np.float32)
        for i, one_hot in enumerate(np.identity(self.shape[0])):
            kernel[i] = self(one_hot)
        return kernel

    @property
    def cost(self) -> float:
        return float(sum(op.cost for op in self.ops))

    @property
    def latency(self) -> tuple[float, float]:
        lats = self.out_latency
        if not lats:
            return 0.0, 0.0
        return min(lats), max(lats)

    @property
    def out_latency(self) -> list[float]:
        return [self.ops[i].latency if i >= 0 else 0.0 for i in self.out_idxs]

    @property
    def out_qint(self) -> list[QInterval]:
        out = []
        for i, idx in enumerate(self.out_idxs):
            if idx < 0:
                out.append(QInterval(0.0, 0.0, 1.0))
                continue
            lo, hi, step = self.ops[idx].qint
            sf = 2.0 ** self.out_shifts[i]
            lo, hi, step = lo * sf, hi * sf, step * sf
            if self.out_negs[i]:
                lo, hi = -hi, -lo
            out.append(QInterval(lo, hi, step))
        return out

    @property
    def out_kifs(self) -> NDArray:
        return np.array([minimal_kif(qi) for qi in self.out_qint]).T

    @property
    def inp_latency(self) -> list[float]:
        return [op.latency for op in self.ops if op.opcode == -1]

    @property
    def inp_qint(self) -> list[QInterval]:
        qints = [QInterval(0.0, 0.0, 1.0) for _ in range(self.shape[0])]
        for op in self.ops:
            if op.opcode == -1:
                qints[op.id0] = op.qint
        return qints

    @property
    def inp_kifs(self) -> NDArray:
        return np.array([minimal_kif(qi) for qi in self.inp_qint]).T

    @property
    def ref_count(self) -> NDArray:
        """Number of downstream references to each buffer slot."""
        rc = np.zeros(len(self.ops), dtype=np.uint64)
        for op in self.ops:
            if op.opcode == -1:
                continue
            if op.id0 != -1:
                rc[op.id0] += 1
            if op.id1 != -1:
                rc[op.id1] += 1
            if op.opcode in (6, -6):
                rc[op.data & 0xFFFFFFFF] += 1
        for i in self.out_idxs:
            if i >= 0:
                rc[i] += 1
        return rc

    def __repr__(self) -> str:
        n_in, n_out = self.shape
        lo, hi = self.latency
        return f'CombLogic([{n_in} -> {n_out}], cost={self.cost}, latency={lo}-{hi})'

    # ------------------------------------------------------------ persistence

    def to_dict(self) -> dict:
        return {
            'shape': list(self.shape),
            'inp_shifts': [int(v) for v in self.inp_shifts],
            'out_idxs': [int(v) for v in self.out_idxs],
            'out_shifts': [int(v) for v in self.out_shifts],
            'out_negs': [int(v) for v in self.out_negs],
            'ops': [[op.id0, op.id1, op.opcode, op.data, list(op.qint), op.latency, op.cost] for op in self.ops],
            'carry_size': self.carry_size,
            'adder_size': self.adder_size,
            'lookup_tables': [t.to_dict() for t in self.lookup_tables] if self.lookup_tables is not None else None,
        }

    @classmethod
    def from_dict(cls, data: dict, verify: bool = True) -> 'CombLogic':
        """Rebuild from ``to_dict`` output.

        ``verify`` (default on) runs the well-formedness analysis pass, so a
        corrupted saved program fails at load with structured diagnostics
        (:class:`~..analysis.VerificationError`) instead of crashing
        mid-replay or emitting wrong RTL.
        """
        ops = [Op(o[0], o[1], o[2], o[3], QInterval(*o[4]), o[5], o[6]) for o in data['ops']]
        tables = data.get('lookup_tables')
        if tables is not None:
            tables = tuple(LookupTable.from_dict(t) for t in tables)
        comb = cls(
            shape=tuple(data['shape']),
            inp_shifts=data['inp_shifts'],
            out_idxs=data['out_idxs'],
            out_shifts=data['out_shifts'],
            out_negs=data['out_negs'],
            ops=ops,
            carry_size=data['carry_size'],
            adder_size=data['adder_size'],
            lookup_tables=tables,
        )
        if verify:
            from ..analysis import verify_or_raise

            verify_or_raise(comb, context='CombLogic.from_dict', passes=('wellformed',))
        return comb

    def save(self, path: str | Path):
        with open(path, 'w') as f:
            json.dump(self.to_dict(), f, separators=(',', ':'))

    @classmethod
    def load(cls, path: str | Path, verify: bool = True) -> 'CombLogic':
        with open(path) as f:
            return cls.from_dict(json.load(f), verify=verify)

    # ---------------------------------------------------------- DAIS binary

    def to_binary(self, version: int = 0) -> NDArray[np.int32]:
        """Serialize to the flat int32 DAIS v1 stream."""
        DAIS_SPEC_VERSION = 1
        n_in, n_out = self.shape
        n_tables = len(self.lookup_tables) if self.lookup_tables is not None else 0

        header = np.concatenate(
            [
                [DAIS_SPEC_VERSION, version, n_in, n_out, len(self.ops), n_tables],
                self.inp_shifts,
                self.out_idxs,
                self.out_shifts,
                np.asarray(self.out_negs, dtype=np.int32),
            ],
            axis=0,
            dtype=np.int32,
        )
        code = np.empty((len(self.ops), 8), dtype=np.int32)
        for i, op in enumerate(self.ops):
            row = code[i]
            row[0] = op.opcode
            row[1] = op.id0
            row[2] = op.id1
            row[5:] = minimal_kif(op.qint)
            data_u64 = row[3:5].view(np.uint64)
            if op.opcode != 8:
                data_u64[0] = op.data & 0xFFFFFFFFFFFFFFFF
            else:
                assert self.lookup_tables is not None
                pad_left = self.lookup_tables[op.data].pads(self.ops[op.id0].qint)[0]
                data_u64[0] = ((pad_left << 32) | op.data) & 0xFFFFFFFFFFFFFFFF
        data = np.concatenate([header, code.ravel()])
        if not self.lookup_tables:  # None or empty tuple: no table section
            return data
        tables = [t.table for t in self.lookup_tables]
        sizes = [len(t) for t in tables]
        return np.concatenate([data, np.concatenate([sizes] + tables, axis=0, dtype=np.int32)])

    def save_binary(self, path: str | Path, version: int = 0):
        self.to_binary(version=version).tofile(str(path))

    # -------------------------------------------------------------- predict

    def predict(
        self, data: NDArray | Sequence[NDArray], backend: str = 'torch', device=None, n_threads: int = 0
    ) -> NDArray[np.float64]:
        """Bit-exact batch inference through the port's runtime (``run_comb``).

        backend: ``'torch'`` (the DAIS executor: the CUDA kernel on a CUDA
        device, its plain torch version on ``device='cpu'``; ``device=None``
        means the card), ``'numpy'`` (the vectorized host interpreter) or
        ``'cpp'`` (the native host interpreter on ``n_threads`` OpenMP
        threads, OpenMP's count when <= 0).
        """
        if isinstance(data, Sequence):
            data = np.concatenate([np.asarray(a).reshape(len(a), -1) for a in data], axis=-1)
        from ..runtime import run_comb

        return run_comb(self, np.asarray(data, dtype=np.float64), backend=backend, device=device, n_threads=n_threads)


class Pipeline(NamedTuple):
    """An II=1 pipeline: a chain of CombLogic stages."""

    stages: tuple[CombLogic, ...]

    def __call__(self, inp, quantize: bool = False):
        out = np.asarray(inp)
        for stage in self.stages:
            out = stage(out, quantize=quantize)
        return out

    @property
    def solutions(self) -> tuple[CombLogic, ...]:
        """Alias kept for API familiarity with the reference."""
        return self.stages

    @property
    def kernel(self):
        return reduce(lambda x, y: x @ y, [s.kernel for s in self.stages])

    @property
    def cost(self):
        return sum(s.cost for s in self.stages)

    @property
    def latency(self):
        return self.stages[-1].latency

    @property
    def shape(self):
        return self.stages[0].shape[0], self.stages[-1].shape[1]

    @property
    def inp_qint(self):
        return self.stages[0].inp_qint

    @property
    def inp_latency(self):
        return self.stages[0].inp_latency

    @property
    def inp_shifts(self):
        return self.stages[0].inp_shifts

    @property
    def out_qint(self):
        return self.stages[-1].out_qint

    @property
    def out_latencies(self):
        return self.stages[-1].out_latency

    @property
    def out_shift(self):
        return self.stages[-1].out_shifts

    @property
    def out_neg(self):
        return self.stages[-1].out_negs

    @property
    def reg_bits(self) -> int:
        """Total pipeline-register bits (input regs + each stage's outputs)."""
        bits = sum(sum(minimal_kif(q)) for q in self.inp_qint)
        for stage in self.stages:
            bits += sum(sum(minimal_kif(q)) for q in stage.out_qint)
        return int(bits)

    def __repr__(self) -> str:
        dims = [s.shape[0] for s in self.stages] + [self.shape[1]]
        lo, hi = self.latency
        return f'Pipeline([{" -> ".join(map(str, dims))}], cost={self.cost}, latency={lo}-{hi})'

    def to_dict(self) -> dict:
        return {'stages': [s.to_dict() for s in self.stages]}

    @classmethod
    def from_dict(cls, data: dict, verify: bool = True) -> 'Pipeline':
        """Rebuild from ``to_dict`` output; with ``verify`` the well-formedness
        pass checks every stage plus the stage-to-stage interfaces."""
        pipe = cls(stages=tuple(CombLogic.from_dict(s, verify=False) for s in data['stages']))
        if verify:
            from ..analysis import verify_or_raise

            verify_or_raise(pipe, context='Pipeline.from_dict', passes=('wellformed',))
        return pipe

    def save(self, path: str | Path):
        with open(path, 'w') as f:
            json.dump(self.to_dict(), f, separators=(',', ':'))

    @classmethod
    def load(cls, path: str | Path, verify: bool = True) -> 'Pipeline':
        with open(path) as f:
            return cls.from_dict(json.load(f), verify=verify)

    def fuse(self, report: bool = False):
        """Merge every stage into ONE well-formed :class:`CombLogic`.

        Inter-stage rescaling becomes explicit seam ops, so the level
        scheduler packs formerly-separate stages' ops into shared
        (level, family) groups. Bit-exact with the staged execution; with
        ``report=True`` also returns the :class:`~.fuse.FusionReport`.
        """
        from .fuse import fuse_pipeline

        return fuse_pipeline(self, report=report)

    def predict(self, data, backend: str = 'torch', device=None, n_threads: int = 0, fused: bool | str = True):
        """Bit-exact batch inference of the whole pipeline.

        ``backend='torch'`` runs the stages through ``run_pipeline`` on
        ``device`` (the card when None): ``fused=True`` chains every stage's
        kernel launch and the exact inter-stage shift on the device behind
        one call boundary (``fused=False``, ``PipelineExecutor.chained``, is
        the same sequence of launches); ``fused='ir'`` merges the stages into
        one DAIS program first (one kernel launch a chunk). ``'numpy'`` and
        ``'cpp'`` run stage by stage on the host with a float boundary between
        stages.
        """
        data = np.asarray(data, dtype=np.float64)
        if backend == 'torch':
            from ..runtime import run_pipeline

            return run_pipeline([s.to_binary() for s in self.stages], data, device=device, fused=fused)
        out = data
        for stage in self.stages:
            out = stage.predict(out, backend=backend, n_threads=n_threads)
        return out
