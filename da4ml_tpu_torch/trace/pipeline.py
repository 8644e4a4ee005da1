"""Pipeline construction: cut a CombLogic into register-separated stages.

:func:`to_pipeline` assigns every op to the stage its latency falls in and
threads register copies through each boundary a value crosses, producing an
II=1 :class:`Pipeline`.  :func:`retime_pipeline` then binary-searches the
smallest latency cutoff that still fits the same stage count — re-executing
the program symbolically under the tighter ``HWConfig`` so the latency-snap
rule in ``FixedVariable.get_cost_and_latency`` redistributes work between
stages.

Counterpart of ``da4ml_tpu/trace/pipeline.py``: the same stages, byte for byte.
"""

from __future__ import annotations

from collections import defaultdict
from math import floor

from .. import telemetry
from ..ir.comb import CombLogic, Pipeline
from ..ir.types import Op
from .fixed_variable import FixedVariable, HWConfig
from .tracer import comb_trace, mux_cond_slot, mux_shift, pack_mux_payload

_logger = telemetry.get_logger('trace.pipeline')


class _StageBuilder:
    """Accumulates per-stage op lists while tracking where each original
    value currently lives (stage → local slot)."""

    def __init__(self, source_ops: list[Op], cutoff: float):
        self._src = source_ops
        self._cutoff = cutoff
        self.ops: defaultdict[int, list[Op]] = defaultdict(list)
        self.outs: defaultdict[int, list[int]] = defaultdict(list)
        self._homes: list[dict[int, int]] = []

    def stage_of(self, latency: float) -> int:
        return floor(latency / (self._cutoff + 1e-9)) if self._cutoff > 0 else 0

    def place(self, stage: int, op: Op) -> None:
        """Append a freshly-lowered op, registering its home stage."""
        lane = self.ops[stage]
        lane.append(op)
        self._homes.append({stage: len(lane) - 1})

    def fetch(self, value: int, stage: int) -> int:
        """Local slot of ``value`` within ``stage``.

        When the value was produced in an earlier stage, a chain of register
        copies (external-fetch ops) is materialized through every boundary in
        between, and each intermediate stage exports it.
        """
        if value < 0:
            return value
        homes = self._homes[value]
        if stage in homes:
            return homes[stage]
        for s in range(max(homes), stage):
            exports = self.outs[s]
            exports.append(homes[s])
            nxt = self.ops[s + 1]
            nxt.append(Op(len(exports) - 1, -1, -1, 0, self._src[value].qint, float(self._cutoff * (s + 1)), 0.0))
            homes[s + 1] = len(nxt) - 1
        return homes[stage]

    def export(self, stage: int, value: int) -> None:
        self.outs[stage].append(self.fetch(value, stage))


def _localize_tables(ops: list[Op], tables: tuple):
    """Renumber lookup ops against only the tables this stage touches."""
    used = sorted({op.data for op in ops if op.opcode == 8})
    renum = {g: i for i, g in enumerate(used)}
    ops = [op._replace(data=renum[op.data]) if op.opcode == 8 else op for op in ops]
    return ops, tuple(tables[g] for g in used)


def to_pipeline(comb: CombLogic, latency_cutoff: float, retiming: bool = True, verbose: bool = False) -> Pipeline:
    """Split a CombLogic into an II=1 pipeline at the given latency cutoff."""
    if not comb.ops:
        raise AssertionError('cannot pipeline an empty program')

    with telemetry.span('trace.to_pipeline', n_ops=len(comb.ops), cutoff=latency_cutoff):
        return _to_pipeline_impl(comb, latency_cutoff, retiming, verbose)


def _to_pipeline_impl(comb: CombLogic, latency_cutoff: float, retiming: bool, verbose: bool) -> Pipeline:
    b = _StageBuilder(list(comb.ops), latency_cutoff)

    for op in comb.ops:
        stage = b.stage_of(op.latency)
        if op.opcode == -1:
            b.place(stage, op)
            continue
        id0 = b.fetch(op.id0, stage)
        id1 = b.fetch(op.id1, stage)
        data = op.data
        if op.opcode in (6, -6):
            data = pack_mux_payload(b.fetch(mux_cond_slot(data), stage), mux_shift(data))
        b.place(stage, op._replace(id0=id0, id1=id1, data=data))

    # every external output leaves from the deepest output's stage
    final_latency = max(comb.ops[i].latency for i in comb.out_idxs)
    out_stage = b.stage_of(final_latency)
    for r in comb.out_idxs:
        b.export(out_stage, r)

    last = max(b.ops)
    stages: list[CombLogic] = []
    width_in = comb.shape[0]
    for s in range(last + 1):
        ops, outs = b.ops[s], b.outs[s]
        if s == last:
            shifts, negs = comb.out_shifts, comb.out_negs
        else:
            shifts, negs = [0] * len(outs), [False] * len(outs)
        tables = comb.lookup_tables
        if tables is not None:
            ops, tables = _localize_tables(ops, tables)
        stages.append(
            CombLogic(
                shape=(width_in, len(outs)),
                inp_shifts=[0] * width_in,
                out_idxs=outs,
                out_shifts=shifts,
                out_negs=negs,
                ops=ops,
                carry_size=comb.carry_size,
                adder_size=comb.adder_size,
                lookup_tables=tables,
            )
        )
        width_in = len(outs)

    pipe = Pipeline(tuple(stages))
    return retime_pipeline(pipe, verbose=verbose) if retiming else pipe


def _resplit(pipe: Pipeline, cutoff: float, adder_size: int, carry_size: int) -> Pipeline | None:
    """Re-trace the pipeline under a tighter cutoff; None when infeasible
    (an op's own delay exceeds the requested stage budget)."""
    hwconf = HWConfig(adder_size, carry_size, cutoff)
    inp = [FixedVariable(*qint, hwconf=hwconf) for qint in pipe.inp_qint]
    try:
        out = list(pipe(inp))
    except AssertionError:
        return None
    return to_pipeline(comb_trace(inp, out), cutoff, retiming=False)


def retime_pipeline(pipe: Pipeline, verbose: bool = False) -> Pipeline:
    """Binary-search the smallest cutoff preserving the stage count."""
    with telemetry.span('trace.retime', n_stages=len(pipe.stages)):
        n_stages = len(pipe.stages)
        adder_size, carry_size = pipe.stages[0].adder_size, pipe.stages[0].carry_size
        hi = max(max(stage.out_latency) / (i + 1) for i, stage in enumerate(pipe.stages))
        lo = max(pipe.out_latencies) / n_stages
        best = pipe
        while hi - lo > 1:
            mid = (hi + lo) // 2
            cand = _resplit(pipe, mid, adder_size, carry_size)
            if cand is None or len(cand.stages) > n_stages:
                lo = mid
            else:
                hi = mid
                best = cand
        if verbose:
            _logger.info(f'retimed latency cutoff: {hi}')
        return best
