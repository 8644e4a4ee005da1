"""Random well-formed DAIS program synthesis (test and smoke-run corpus).

The executor parity checks need DAIS programs that (a) cover every opcode
family — including LUT ops, negative shifts, muxes and bitwise ops the CMVM
solver rarely emits — and (b) are *semantically safe* on every backend:
lookup indices in bounds, msb-mux branch shifts per the interpreter contract,
and value magnitudes tracked so narrow programs stay exactly representable on
the int32 device path (the reference interpreter computes in int64;
bit-exactness requires intermediates to agree mod 2^32).

Counterpart of ``da4ml_tpu/ir/synth.py`` (``random_program``, ``random_pipeline``,
``random_inputs``, ``opcode_counts``):
the same generator, draw for draw, so a seed gives the same program in both.
"""

from __future__ import annotations

import numpy as np

from .dais_binary import DaisProgram
from .optable import OP_TABLE

#: opcode families the generator can emit (keys for the ``families`` arg)
FAMILIES = ('add', 'relu', 'quant', 'cadd', 'const', 'mux', 'mul', 'lookup', 'bitu', 'bitb')

# coverage audit: every row of the opcode table must name a generator family
# here (copy ops are implicit — one per input lane of every program)
_uncovered = [spec.key for spec in OP_TABLE if spec.synth_family is not None and spec.synth_family not in FAMILIES]
_stale = [f for f in FAMILIES if f not in {spec.synth_family for spec in OP_TABLE}]
if _uncovered or _stale:
    raise RuntimeError(f'ir.synth families out of step with the opcode table: uncovered {_uncovered}, stale {_stale}')


def opcode_counts(progs) -> dict[int, int]:
    """Per-opcode op counts over a corpus of :class:`DaisProgram` — the
    coverage numbers of the ``--fuzz`` report."""
    counts: dict[int, int] = {oc: 0 for spec in OP_TABLE for oc in spec.opcodes}
    for prog in progs:
        for oc in prog.opcode.tolist():
            counts[int(oc)] = counts.get(int(oc), 0) + 1
    return counts


def _width_for(bound: int, f: int) -> int:
    """Signed width holding values in [-bound, bound] at ``f`` fractional bits."""
    return max(int(bound).bit_length() + 1, f + 1, 1)


def random_program(
    rng: np.random.Generator,
    n_ops: int = 200,
    n_in: int = 6,
    n_out: int = 5,
    families: tuple[str, ...] = FAMILIES,
    wide: bool = False,
    n_levels: int | None = None,
) -> DaisProgram:
    """Generate a random well-formed DAIS program.

    ``wide=True`` makes the inputs ~32 integer bits so the executor must take
    the int64 path. ``n_levels`` arranges the non-input ops into that many
    dependency layers with operands drawn only from the previous layer.
    """
    assert n_ops > n_in >= 1
    limit = (1 << 58) if wide else (1 << 26)
    max_f = 6

    opcode = np.full(n_ops, 0, np.int64)
    id0 = np.full(n_ops, -1, np.int64)
    id1 = np.full(n_ops, -1, np.int64)
    dlo = np.zeros(n_ops, np.int64)
    dhi = np.zeros(n_ops, np.int64)
    sg = np.ones(n_ops, np.int64)
    fr = np.zeros(n_ops, np.int64)
    it = np.zeros(n_ops, np.int64)
    bound = np.zeros(n_ops, dtype=object)  # python ints: wide bounds overflow int64 ops
    tables: list[np.ndarray] = []

    def width(j: int) -> int:
        return int(sg[j] + it[j] + fr[j])

    def finish(i: int, f: int, b: int) -> None:
        """Record fractional bits / integers sized to the magnitude bound."""
        fr[i] = f
        it[i] = max(_width_for(b, f) - 1 - f, 0)
        bound[i] = int(b)

    for i in range(n_in):
        opcode[i] = -1
        id0[i] = i
        f = int(rng.integers(0, 4))
        integers = int(rng.integers(28, 33)) if wide else int(rng.integers(2, 5))
        fr[i] = f
        it[i] = integers
        bound[i] = 1 << (integers + f)  # wrapped to signed width

    def pick(pool: list[int]) -> int:
        return int(pool[int(rng.integers(0, len(pool)))])

    if n_levels is not None:
        per_level = max((n_ops - n_in) // max(n_levels, 1), 1)

    prev_layer = list(range(n_in))
    layer_start = n_in

    for i in range(n_in, n_ops):
        if n_levels is not None and i - layer_start >= per_level:
            prev_layer = list(range(layer_start, i))
            layer_start = i
        pool = prev_layer if n_levels is not None else list(range(i))
        fam = families[int(rng.integers(0, len(families)))]
        a = pick(pool)
        b = pick(pool)
        f0, f1 = int(fr[a]), int(fr[b])

        if fam == 'mul' and int(bound[a]) * int(bound[b]) > limit:
            fam = 'quant'
        if fam == 'lookup':
            lut_pool = [j for j in pool if width(j) <= 8]
            if not lut_pool:
                fam = 'quant'
            else:
                a = pick(lut_pool)
                f0 = int(fr[a])

        if fam == 'add':
            shift = int(rng.integers(-2, 3))
            a_shift = shift + f0 - f1
            nb = int(bound[a]) + (int(bound[b]) << a_shift) if a_shift > 0 else (int(bound[a]) << -a_shift) + int(bound[b])
            if nb > limit:
                fam = 'quant'
            else:
                maxf = max(f0, f1 - shift)
                g = int(rng.integers(0, min(2, max(maxf, 0)) + 1))
                f = maxf - g
                if f > max_f:
                    g, f = maxf - max_f, max_f
                opcode[i] = int(rng.integers(0, 2))  # add or sub
                id0[i], id1[i], dlo[i] = a, b, shift
                finish(i, max(f, 0), nb >> max(g, 0))
                continue
        if fam in ('relu', 'quant'):
            f = int(rng.integers(0, 4))
            integers = int(rng.integers(1, min(4, max(8 - f - 1, 2))))
            base = 2 if fam == 'relu' else 3
            opcode[i] = base if rng.integers(0, 2) else -base
            id0[i] = a
            sg[i], it[i], fr[i] = 1, integers, f
            bound[i] = 1 << (integers + f)
        elif fam == 'cadd':
            shift = int(rng.integers(-1, 2))
            f = min(max(f0 + shift, 0), max_f)
            c = int(rng.integers(-31, 32))
            nb = (int(bound[a]) << max(f - f0, 0)) + 31
            if nb > limit:
                opcode[i] = 3
                id0[i] = a
                sg[i], it[i], fr[i] = 1, 2, 0
                bound[i] = 1 << 2
            else:
                opcode[i] = 4
                id0[i] = a
                dlo[i], dhi[i] = c, (-1 if c < 0 else 0)
                finish(i, f, nb)
        elif fam == 'const':
            c = int(rng.integers(-100, 101))
            opcode[i] = 5
            dlo[i], dhi[i] = c, (-1 if c < 0 else 0)
            finish(i, int(rng.integers(0, 3)), abs(c))
        elif fam == 'mux':
            ic = pick(pool)
            f = f0
            opcode[i] = 6 if rng.integers(0, 2) else -6
            id0[i], id1[i] = a, b
            dlo[i], dhi[i] = ic, f1 - f  # cond slot; branch-1 shift zeroes out
            integers = int(rng.integers(1, 5))
            sg[i], it[i], fr[i] = 1, integers, f
            bound[i] = 1 << (integers + f)
        elif fam == 'mul':
            opcode[i] = 7
            id0[i], id1[i] = a, b
            finish(i, min(f0 + f1, max_f), int(bound[a]) * int(bound[b]))
        elif fam == 'lookup':
            w0 = width(a)
            f = int(rng.integers(0, 3))
            integers = int(rng.integers(1, 5))
            table = rng.integers(-(1 << (integers + f)), 1 << (integers + f), 1 << w0).astype(np.int32)
            opcode[i] = 8
            id0[i], dlo[i], dhi[i] = a, len(tables), 0
            tables.append(table)
            sg[i], it[i], fr[i] = 1, integers, f
            bound[i] = 1 << (integers + f)
        elif fam == 'bitu':
            sub = int(rng.integers(0, 3))
            opcode[i] = 9 if rng.integers(0, 2) else -9
            id0[i], dlo[i] = a, sub
            finish(i, f0 if sub == 0 else 0, int(bound[a]) + 1 if sub == 0 else 1)
        elif fam == 'bitb':
            shift = int(rng.integers(-2, 3))
            a_shift = shift + f0 - f1
            b1s = int(bound[b]) << max(a_shift, 0)
            b0s = int(bound[a]) << max(-a_shift, 0)
            nb = b0s + b1s + 1
            if nb > limit:
                opcode[i] = 3
                id0[i] = a
                sg[i], it[i], fr[i] = 1, 2, 0
                bound[i] = 1 << 2
            else:
                subop = int(rng.integers(0, 3))
                flags = int(rng.integers(0, 2)) | (int(rng.integers(0, 2)) << 1)
                opcode[i] = 10
                id0[i], id1[i] = a, b
                dlo[i], dhi[i] = shift, (subop << 24) | flags
                finish(i, min(max(f0, f1 - shift), max_f), nb)
        else:  # 'quant' fallback from the bound guards above
            f = int(rng.integers(0, 4))
            integers = int(rng.integers(1, 4))
            opcode[i] = 3 if rng.integers(0, 2) else -3
            id0[i] = a
            sg[i], it[i], fr[i] = 1, integers, f
            bound[i] = 1 << (integers + f)

    out_idxs = rng.integers(n_in, n_ops, n_out).astype(np.int64)
    if n_out > 1:
        out_idxs[int(rng.integers(0, n_out))] = -1  # exercise the hole path
    out_negs = rng.integers(0, 2, n_out)
    out_shifts = rng.integers(-2, 3, n_out)
    inp_shifts = rng.integers(-1, 2, n_in)

    return DaisProgram(
        n_in=n_in,
        n_out=n_out,
        inp_shifts=inp_shifts.astype(np.int32),
        out_idxs=out_idxs.astype(np.int32),
        out_shifts=out_shifts.astype(np.int32),
        out_negs=out_negs.astype(np.int32),
        opcode=opcode.astype(np.int32),
        id0=id0.astype(np.int32),
        id1=id1.astype(np.int32),
        data_lo=dlo.astype(np.int32),
        data_hi=dhi.astype(np.int32),
        signed=sg.astype(np.int32),
        integers=it.astype(np.int32),
        fractionals=fr.astype(np.int32),
        tables=tuple(tables),
    )


def random_pipeline(
    rng: np.random.Generator,
    n_stages: int = 3,
    n_ops: int = 120,
    families: tuple[str, ...] = FAMILIES,
    n_levels: int | None = None,
) -> tuple[DaisProgram, ...]:
    """A random well-formed multi-stage pipeline (stage chain).

    Each stage is a :func:`random_program` with mixed lane counts and
    fractionals; consecutive stages agree on lane count, so the chain is a
    valid ``runtime.run_pipeline`` / ``ir.fuse.fuse_binaries`` input.
    Mid-pipeline stages keep the chained-boundary contract of
    ``PipelineExecutor`` (a stage boundary is a pure arithmetic shift of live
    output lanes): no output negation and no dead ``-1`` lanes except on the
    final stage. Stages stay narrow (``wide=False``) so inter-stage codes are
    exact in float64 on every backend.
    """
    assert n_stages >= 1
    widths = [int(rng.integers(3, 7)) for _ in range(n_stages + 1)]
    stages: list[DaisProgram] = []
    for s in range(n_stages):
        prog = random_program(
            rng,
            n_ops=n_ops,
            n_in=widths[s],
            n_out=widths[s + 1],
            families=families,
            wide=False,
            n_levels=n_levels,
        )
        if s < n_stages - 1:
            out_idxs = prog.out_idxs.copy()
            out_idxs[out_idxs < 0] = int(prog.n_in)  # first non-input op: always present
            prog = prog._replace(out_idxs=out_idxs, out_negs=np.zeros_like(prog.out_negs))
        stages.append(prog)
    return tuple(stages)


def random_inputs(rng: np.random.Generator, prog: DaisProgram, n_samples: int) -> np.ndarray:
    """A float input batch exercising the full wrapped input range."""
    return rng.uniform(-16, 16, (n_samples, prog.n_in))
