"""Deterministic IR corruption harness for verifier self-tests.

Each :class:`Corruption` damages one field of one op of a given DAIS opcode
family and names the verifier rule that must catch it. The per-opcode
entries are *generated* from the declarative opcode table — every
``OpSpec.mutations`` row of ``ir/optable.py`` becomes a catalog entry, so a
new opcode ships with its corruption (and its detection test) by
construction, with no hand-maintained list to drift. Only the container-
level corruptions (io bindings, cost fields, pipeline interfaces) live
here, since they are not tied to an opcode.

The mutation self-test (tests/test_torch_analysis.py) asserts every catalog
entry is caught with a structured diagnostic; the catalog covers every
opcode family of the DAIS v1 table by construction.

Counterpart of ``da4ml_tpu/analysis/mutation.py``, without
``apply_planned_corruptions``: it reads the reliability fault plan, which
the port does not carry yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import nan
from typing import Callable

from ..ir.comb import CombLogic, Pipeline
from ..ir.optable import OP_TABLE, _find_op, mutate_op


def _corrupt_outputs_dead(comb: CombLogic) -> CombLogic:
    copy = _find_op(comb, (-1,))
    return comb._replace(out_idxs=[copy] * len(comb.out_idxs))


def _corrupt_out_binding(comb: CombLogic) -> CombLogic:
    out = list(comb.out_idxs)
    out[0] = len(comb.ops) + 5
    return comb._replace(out_idxs=out)


def _corrupt_inp_shifts(comb: CombLogic) -> CombLogic:
    return comb._replace(inp_shifts=list(comb.inp_shifts)[:-1])


def _corrupt_stage_interface(pipe: Pipeline) -> Pipeline:
    s0 = pipe.stages[0]
    s0 = s0._replace(
        shape=(s0.shape[0], s0.shape[1] - 1),
        out_idxs=list(s0.out_idxs)[:-1],
        out_shifts=list(s0.out_shifts)[:-1],
        out_negs=list(s0.out_negs)[:-1],
    )
    return Pipeline(stages=(s0,) + pipe.stages[1:])


@dataclass(frozen=True)
class Corruption:
    """One catalogued IR corruption: what it damages and who must catch it."""

    name: str  # e.g. 'add.forward_ref'
    family: str  # DAIS opcode family it targets
    expect_rule: str  # verifier rule id that must flag it
    apply: Callable  # CombLogic -> CombLogic (or Pipeline -> Pipeline)


#: container-level corruptions: not tied to one opcode row
_CONTAINER_CORRUPTIONS: tuple[Corruption, ...] = (
    Corruption('any.unknown_opcode', 'any', 'W102', lambda c: mutate_op(c, (0, 1), opcode=42)),
    Corruption('any.nan_latency', 'any', 'D302', lambda c: mutate_op(c, (0, 1), latency=nan)),
    Corruption('any.negative_cost', 'any', 'D302', lambda c: mutate_op(c, (2, -2, 3, -3), cost=-1.0)),
    Corruption('io.out_of_range_output', 'io', 'W105', _corrupt_out_binding),
    Corruption('io.truncated_inp_shifts', 'io', 'W101', _corrupt_inp_shifts),
    Corruption('io.dead_subgraph', 'io', 'D301', _corrupt_outputs_dead),
)

#: one corruption family per opcode-table row, plus the container-level set
COMB_CORRUPTIONS: tuple[Corruption, ...] = tuple(
    Corruption(m.name, spec.family, m.expect_rule, m.apply) for spec in OP_TABLE for m in spec.mutations
) + _CONTAINER_CORRUPTIONS

PIPELINE_CORRUPTIONS: tuple[Corruption, ...] = (
    Corruption('pipeline.stage_interface', 'pipeline', 'W120', _corrupt_stage_interface),
)


def corruption_by_name(name: str) -> Corruption:
    for c in COMB_CORRUPTIONS + PIPELINE_CORRUPTIONS:
        if c.name == name:
            return c
    raise KeyError(f'unknown corruption {name!r}')


__all__ = [
    'COMB_CORRUPTIONS',
    'PIPELINE_CORRUPTIONS',
    'Corruption',
    'corruption_by_name',
]
